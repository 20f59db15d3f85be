"""Adaptive homoscedastic-uncertainty multi-task losses (NCHW).

Counterparts of ``srbh_tpu/losses/adaptive.py`` (losses_pytorch/selfloss.py):
pure functions, with each task's ``log_var`` held by the train state
(``srbh_tpu_torch.train.state``). Weighting recipe (selfloss.py:81-90):
``loss * exp(-log_var) + log_var``.

The class axis of logits and probabilities is dim 1 (NCHW), where the JAX
functions take it last. Labels outside ``[0, C-1]`` are clamped into it, as
the JAX ``pick_class`` does (``F.cross_entropy`` would raise on them).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _adapt(loss: torch.Tensor, log_var: torch.Tensor) -> torch.Tensor:
    return loss * torch.exp(-log_var) + log_var


def _clamp_labels(labels: torch.Tensor, num_classes: int) -> torch.Tensor:
    return labels.long().clamp(0, num_classes - 1)


def pick_class(values: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """``values[:, labels]`` along the class axis (dim 1), labels clamped to
    ``[0, C-1]``: (N, C, ...) values and (N, ...) labels -> (N, ...)."""
    lab = _clamp_labels(labels, values.shape[1])
    return values.gather(1, lab.unsqueeze(1)).squeeze(1)


def mse_adapt(pred, target, log_var):
    """MSE with uncertainty weighting (selfloss.py:71-79)."""
    return _adapt(torch.mean((pred - target) ** 2), log_var)


def mse_adapt_weight(pred, target, weight, log_var):
    """Pixel-weighted MSE with uncertainty weighting (selfloss.py:81-90)."""
    return _adapt(torch.mean(((pred - target) ** 2) * weight), log_var)


def _lut(table: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``table[index]`` with the JAX package's index rules: a negative index
    counts from the end, and one still out of range is clamped."""
    n = table.shape[0]
    index = index.long()
    return table[torch.where(index < 0, index + n, index).clamp(0, n - 1)]


def mse_adapt_weight_hir(pred, target, log_var, buildhir, heightweight):
    """Variant deriving the pixel weight from the target's hierarchy class
    through the LUTs (selfloss.py:93-108)."""
    weight = _lut(heightweight, _lut(buildhir, target))
    return _adapt(torch.mean(((pred - target) ** 2) * weight), log_var)


def weighted_mse(pred, target, weight):
    """Plain weighted MSE (selfloss.py:50-59)."""
    return torch.mean(((pred - target) ** 2) * weight)


def smooth_l1(pred, target):
    """sigmoid + huber(delta=1) on logits (selfloss.py:40-48)."""
    return F.huber_loss(torch.sigmoid(pred), target, delta=1.0)


def dice_binary(prob, target, smooth: float = 1.0):
    """Soft dice on a foreground-probability map (selfloss.py:6-17): one
    global dice over the flattened batch."""
    p = prob.reshape(-1)
    t = target.reshape(-1).to(prob.dtype)
    inter = torch.sum(p * t)
    return 1.0 - (2.0 * inter + smooth) / (torch.sum(p) + torch.sum(t) + smooth)


def softmax_cross_entropy(logits, labels, weight=None):
    """Per-pixel CE over (N, C, ...) logits with integer labels:
    ``nn.CrossEntropyLoss(reduction='none')`` then ``mean(weight * ce)``
    (or the plain mean)."""
    ce = F.cross_entropy(logits, _clamp_labels(labels, logits.shape[1]),
                         reduction="none")
    if weight is None:
        return torch.mean(ce)
    return torch.mean(ce * weight)


def ce_dice(logits, labels):
    """Unweighted CE + dice on the class-1 probability (selfloss.py:20-37)."""
    ce = softmax_cross_entropy(logits, labels)
    return ce + dice_binary(torch.softmax(logits, dim=1)[:, 1], labels)


def ce_dice_adapt(logits, labels, log_var):
    """CE + foreground dice with uncertainty weighting (selfloss.py:122-142).
    Foreground probability = sum of the softmax over classes >= 1."""
    ce = softmax_cross_entropy(logits, labels)
    prob_fg = torch.softmax(logits, dim=1)[:, 1:].sum(dim=1)
    return _adapt(ce + dice_binary(prob_fg, labels > 0), log_var)


def ce_dice_adapt_weight(logits, labels, weight, log_var):
    """Weighted CE + foreground dice with uncertainty weighting
    (selfloss.py:145-168): the build-segmentation loss of the main model."""
    ce = softmax_cross_entropy(logits, labels, weight)
    prob_fg = torch.softmax(logits, dim=1)[:, 1:].sum(dim=1)
    return _adapt(ce + dice_binary(prob_fg, labels > 0), log_var)
