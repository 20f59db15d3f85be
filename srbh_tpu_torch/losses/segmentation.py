"""The segmentation loss library (NCHW): the reference's ``losses_pytorch/``.

Counterpart of ``srbh_tpu/losses/segmentation.py`` (dice_loss.py,
boundary_loss.py, focal_loss.py, lovasz_loss.py, iou_loss.py,
ND_Crossentropy.py, hausdorff.py and myloss.py's composites), as functions of
logits (N, C, ...) with the class axis at dim 1 and integer labels (N, ...).

Conventions as in the JAX package: softmax over the classes where the
reference applies one, ``batch_dice`` pools the sums over the batch, and
``do_bg=False`` leaves class 0 out of the mean (nnU-Net's). The distance
maps of the boundary and Hausdorff losses are computed on the host with
``scipy.ndimage.distance_transform_edt`` (:func:`edts_penalized_map`,
:func:`one_hot_distance_transform`) and passed in.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from scipy.ndimage import distance_transform_edt

from srbh_tpu_torch.losses.adaptive import (
    dice_binary,
    pick_class,
    softmax_cross_entropy,
)
from srbh_tpu_torch.losses.sr import _bce_with_logits
from srbh_tpu_torch.losses.ssim_loss import ssim_same


def _one_hot(labels, num_classes):
    """(N, ...) labels -> (N, C, ...) float one-hot."""
    return F.one_hot(labels.long(), num_classes).movedim(-1, 1).float()


def _sum_dims(x, batch_dice: bool):
    """The spatial dims of (N, C, ...), and the batch with ``batch_dice``."""
    return ((0,) if batch_dice else ()) + tuple(range(2, x.ndim))


def _probs_onehot(logits, labels):
    return torch.softmax(logits, dim=1), _one_hot(labels, logits.shape[1])


def _tp_fp_fn(probs, onehot, batch_dice: bool, square: bool = False):
    """Per-class TP / FP / FN sums (dice_loss.py:31-80): (C,) or (N, C)."""
    dims = _sum_dims(probs, batch_dice)
    tp = probs * onehot
    fp = probs * (1 - onehot)
    fn = (1 - probs) * onehot
    if square:
        tp, fp, fn = tp**2, fp**2, fn**2
    return tp.sum(dims), fp.sum(dims), fn.sum(dims)


def soft_dice_loss(logits, labels, batch_dice: bool = False, do_bg: bool = True,
                   smooth: float = 1.0):
    """nnU-Net's SoftDiceLoss (dice_loss.py:255-290): -mean dice."""
    tp, fp, fn = _tp_fp_fn(*_probs_onehot(logits, labels), batch_dice)
    dc = (2 * tp + smooth) / (2 * tp + fp + fn + smooth)
    return -(dc if do_bg else dc[..., 1:]).mean()


def iou_loss(logits, labels, batch_dice: bool = False, do_bg: bool = True,
             smooth: float = 1.0):
    """IoULoss (dice_loss.py:293-330): -mean IoU."""
    tp, fp, fn = _tp_fp_fn(*_probs_onehot(logits, labels), batch_dice)
    iou = (tp + smooth) / (tp + fp + fn + smooth)
    return -(iou if do_bg else iou[..., 1:]).mean()


def tversky_loss(logits, labels, alpha: float = 0.3, beta: float = 0.7,
                 batch_dice: bool = False, do_bg: bool = True,
                 smooth: float = 1.0):
    """TverskyLoss (dice_loss.py:333-371)."""
    tp, fp, fn = _tp_fp_fn(*_probs_onehot(logits, labels), batch_dice)
    tv = (tp + smooth) / (tp + alpha * fp + beta * fn + smooth)
    return -(tv if do_bg else tv[..., 1:]).mean()


def focal_tversky_loss(logits, labels, gamma: float = 0.75, **tversky_kwargs):
    """FocalTversky (dice_loss.py:374-390): (1 + tversky_loss)^gamma."""
    return torch.pow(1 + tversky_loss(logits, labels, **tversky_kwargs), gamma)


def asym_loss(logits, labels, beta: float = 1.5, batch_dice: bool = False,
              smooth: float = 1.0):
    """AsymLoss (dice_loss.py:393-432): FP and FN weighted by
    beta^2 / (1 + beta^2)."""
    tp, fp, fn = _tp_fp_fn(*_probs_onehot(logits, labels), batch_dice)
    w = (beta**2) / (1 + beta**2)
    return -((tp + smooth) / (tp + w * fn + (1 - w) * fp + smooth)).mean()


def ss_loss(logits, labels, r: float = 0.1, batch_dice: bool = False,
            smooth: float = 1.0):
    """Sensitivity-specificity loss (dice_loss.py:192-252)."""
    probs, onehot = _probs_onehot(logits, labels)
    dims = _sum_dims(probs, batch_dice)
    sq = (onehot - probs) ** 2
    spec = (sq * onehot).sum(dims) / (onehot.sum(dims) + smooth)
    sens = (sq * (1 - onehot)).sum(dims) / ((1 - onehot).sum(dims) + smooth)
    return (r * spec + (1 - r) * sens).mean()


def gdice_loss(logits, labels, smooth: float = 1e-5):
    """Generalised dice with 1 / volume^2 class weights per sample
    (dice_loss.py:84-128), negative like the reference's ``-2(...)``."""
    probs, onehot = _probs_onehot(logits, labels)
    spatial = tuple(range(2, probs.ndim))
    vol = onehot.sum(spatial)  # (N, C)
    w = 1.0 / (vol + 1e-10) ** 2
    inter = w * (probs * onehot).sum(spatial)
    union = w * (probs.sum(spatial) + vol)
    return (-2.0 * (inter.sum(-1) + smooth) / (union.sum(-1) + smooth)).mean()


def gdice_loss_v2(logits, labels, smooth: float = 1e-5):
    """GDiceLossV2 (dice_loss.py:143-190): class weights over the whole
    batch, ``1 / sum^2`` clamped at ``smooth``, one global ``-2 I / D``."""
    probs, onehot = _probs_onehot(logits, labels)
    c = probs.shape[1]
    inp = probs.movedim(1, 0).reshape(c, -1)
    tgt = onehot.movedim(1, 0).reshape(c, -1)
    tsum = tgt.sum(-1)
    w = 1.0 / torch.clamp(tsum * tsum, min=smooth)
    intersect = ((inp * tgt).sum(-1) * w).sum()
    denom = ((inp + tgt).sum(-1) * w).sum()
    return -2.0 * intersect / torch.clamp(denom, min=smooth)


def penalty_gdice_loss(logits, labels, k: float = 2.5, smooth: float = 1e-5):
    """PenaltyGDiceLoss (dice_loss.py:445-459): ``gdc / (1 + k (1 - gdc))``."""
    gdc = gdice_loss(logits, labels, smooth)
    return gdc / (1.0 + k * (1.0 - gdc))


def edts_penalized_map(mask: np.ndarray) -> np.ndarray:
    """compute_edts_forPenalizedLoss (ND_Crossentropy.py:151-165): for each
    sample, ``(max - EDT) * mask / max`` of the foreground plus the same of
    the background, on the host. (N, ...) mask -> float32 map."""
    mask = np.asarray(mask).astype(bool)
    res = np.zeros(mask.shape, np.float32)
    for i in range(mask.shape[0]):
        pos, neg = mask[i], ~mask[i]
        pe = distance_transform_edt(pos)
        pe = (pe.max() - pe) * pos
        ne = distance_transform_edt(neg)
        ne = (ne.max() - ne) * neg
        if pe.max() > 0:
            res[i] += pe / pe.max()
        if ne.max() > 0:
            res[i] += ne / ne.max()
    return res


def dist_binary_dice_loss(logits, labels, dist, smooth: float = 1e-5):
    """DistBinaryDiceLoss (boundary_loss.py:192-241): binary dice with the
    TP sum weighted by ``dist`` (``edts_penalized_map(gt > 0) + 1``)."""
    probs = torch.softmax(logits, dim=1)[:, 1]
    gt = (labels > 0).to(probs.dtype)
    dims = tuple(range(1, probs.ndim))
    tp = torch.sum(probs * gt * dist, dims)
    dc = (2 * tp + smooth) / (torch.sum(probs, dims) + torch.sum(gt, dims) + smooth)
    return -dc.mean()


def focal_loss(logits, labels, alpha=None, gamma: float = 2.0,
               balance_index: int = 0, smooth: float = 1e-5):
    """FocalLoss (focal_loss.py:7-93): -alpha_t (1 - p_t)^gamma log p_t,
    p_t clamped to [smooth, 1 - smooth]."""
    num_class = logits.shape[1]
    probs = torch.softmax(logits, dim=1).movedim(1, -1).reshape(-1, num_class)
    target = labels.reshape(-1).long()
    if alpha is None:
        alpha_vec = torch.ones(num_class)
    elif isinstance(alpha, (list, tuple, np.ndarray)):
        a = torch.tensor(np.asarray(alpha, np.float32))
        alpha_vec = a / a.sum()
    else:
        alpha_vec = torch.full((num_class,), 1 - float(alpha))
        alpha_vec[balance_index] = float(alpha)
    pt = pick_class(probs, target)
    if smooth:
        pt = torch.clamp(pt, smooth, 1.0 - smooth)
    at = alpha_vec.to(probs.device)[target]
    return (-at * torch.pow(1 - pt, gamma) * torch.log(pt)).mean()


def _lovasz_grad(gt_sorted):
    """The Lovasz extension's gradient at sorted errors (lovasz_loss.py:7-19)."""
    gts = gt_sorted.sum()
    intersection = gts - torch.cumsum(gt_sorted, 0)
    union = gts + torch.cumsum(1.0 - gt_sorted, 0)
    jaccard = 1.0 - intersection / union
    return torch.cat([jaccard[:1], jaccard[1:] - jaccard[:-1]])


def lovasz_softmax(probs, labels):
    """LovaszSoftmax (lovasz_loss.py:22-69) of softmax outputs (N, C, ...),
    the mean over the classes."""
    num_classes = probs.shape[1]
    flat = probs.movedim(1, -1).reshape(-1, num_classes)
    target = labels.reshape(-1)
    losses = []
    for c in range(num_classes):
        tc = (target == c).to(flat.dtype)
        errors, order = torch.sort(torch.abs(tc - flat[:, c]), descending=True)
        losses.append(torch.dot(errors, _lovasz_grad(tc[order])))
    return torch.stack(losses).mean()


def _pixel_ce(logits, labels):
    return -pick_class(torch.log_softmax(logits, dim=1), labels)


def topk_ce_loss(logits, labels, k: float = 10.0):
    """TopKLoss (ND_Crossentropy.py:38-53): the mean of the top k % of the
    pixels' cross-entropies."""
    flat = _pixel_ce(logits, labels).reshape(-1)
    num = max(1, int(flat.shape[0] * k / 100))
    return torch.topk(flat, num).values.mean()


def weighted_ce_loss(logits, labels, weight: Optional[Sequence[float]] = None):
    """WeightedCrossEntropyLoss (ND_Crossentropy.py:56-80)."""
    ce = _pixel_ce(logits, labels)
    if weight is None:
        return ce.mean()
    w = torch.tensor(np.asarray(weight, np.float32), device=ce.device)[labels.long()]
    return (ce * w).sum() / torch.clamp(w.sum(), min=1e-8)


def dist_penalized_ce(logits, labels, dist_map):
    """DisPenalizedCE (ND_Crossentropy.py:168-208). The reference computes
    the distance weighting and returns the plain ``loss.mean()``, so
    ``dist_map`` does not change the value."""
    del dist_map
    return _pixel_ce(logits, labels).mean()


def nll_loss(log_probs, labels):
    """nll_loss (ND_Crossentropy.py:211-220) of (N, C) log-probabilities."""
    return -pick_class(log_probs, labels).mean()


def boundary_loss(logits, dist_map):
    """BDLoss (boundary_loss.py:82-109): the mean of the non-background
    classes' probabilities times the signed distance map (N, C, ...)."""
    probs = torch.softmax(logits, dim=1)
    return torch.mean(probs[:, 1:] * dist_map[:, 1:])


def hausdorff_dt_loss(logits, labels, dist_pred, dist_gt, alpha: float = 2.0):
    """HausdorffDTLoss (hausdorff.py:19-104): (p - g)^2 (dt_p^a + dt_g^a)."""
    probs = torch.softmax(logits, dim=1)[:, 1]
    err = (probs - (labels > 0).to(probs.dtype)) ** 2
    return (err * (torch.pow(dist_pred, alpha) + torch.pow(dist_gt, alpha))).mean()


def one_hot_distance_transform(labels: np.ndarray, num_classes: int,
                               signed: bool = True) -> np.ndarray:
    """The host EDT of each class mask: (N, H, W) labels -> (N, C, H, W);
    ``signed`` gives + outside and - inside (boundary_loss.py:35-79)."""
    labels = np.asarray(labels)
    out = np.zeros((labels.shape[0], num_classes) + labels.shape[1:], np.float32)
    for b in range(labels.shape[0]):
        for c in range(num_classes):
            mask = labels[b] == c
            if not mask.any():
                continue
            out[b, c] = distance_transform_edt(~mask)
            if signed:
                out[b, c] -= distance_transform_edt(mask)
    return out


# ------------------------------------------------------------- composites

def dc_and_ce_loss(logits, labels, weight_ce: float = 1.0,
                   weight_dice: float = 1.0):
    """DC_and_CE_loss (dice_loss.py:435-460)."""
    return (weight_ce * softmax_cross_entropy(logits, labels)
            + weight_dice * soft_dice_loss(logits, labels))


def dc_and_topk_loss(logits, labels, k: float = 10.0):
    """DC_and_topk_loss (dice_loss.py:481-507)."""
    return topk_ce_loss(logits, labels, k) + soft_dice_loss(logits, labels)


def dc_and_bd_loss(logits, labels, dist_map, alpha: float = 1.0):
    """DC_and_BD_loss (boundary_loss.py:112-137)."""
    return alpha * soft_dice_loss(logits, labels) + boundary_loss(logits, dist_map)


def explog_loss(logits, labels, gamma: float = 0.3, w_dice: float = 0.8,
                w_ce: float = 0.2):
    """ExpLog_loss (dice_loss.py:480-503): the exp-log on the dice term
    only, the cross-entropy term linear, as the reference's code does."""
    dc = soft_dice_loss(logits, labels)
    expdice = torch.pow(-torch.log(torch.clamp(-dc, min=1e-6)), gamma)
    return w_dice * expdice + w_ce * weighted_ce_loss(logits, labels)


def ce_mse_loss(seg_logits, seg_labels, bd_pred, bd_target, beta: float = 0.7):
    """CE_MSE (myloss.py:8-18): cross-entropy plus ``beta`` x the MSE of the
    boundary map against ``rbd / 255``."""
    mse = torch.mean((bd_pred - bd_target.float() / 255.0) ** 2)
    return softmax_cross_entropy(seg_logits, seg_labels) + beta * mse


def _binary_iou(prob, target):
    """The composites' IoU term (iou_loss.py:6-28): 1 - I / U of each
    image, unsmoothed, averaged over the batch."""
    p = prob.reshape(prob.shape[0], -1)
    t = target.reshape(target.shape[0], -1).to(prob.dtype)
    inter = torch.sum(p * t, dim=-1)
    union = torch.sum(p, dim=-1) + torch.sum(t, dim=-1) - inter
    return torch.mean(1.0 - inter / union)


def bce_ssim_iou_loss(logits, target01, data_range: float = 1.0):
    """BCE + (1 - SSIM) + IoU of binary maps (myloss.py:33-77); ``logits``
    and ``target01`` are (N, 1, H, W)."""
    prob = torch.sigmoid(logits)
    t = target01.to(prob.dtype)
    return (_bce_with_logits(logits, t)
            + (1.0 - ssim_same(prob, t, data_range=data_range))
            + _binary_iou(prob, t))


def bce_iou_loss(logits, target01):
    """BCE + IoU of binary maps (myloss.py:38-53)."""
    prob = torch.sigmoid(logits)
    t = target01.to(prob.dtype)
    return _bce_with_logits(logits, t) + _binary_iou(prob, t)


def bce_ssim_loss(logits, target01, data_range: float = 1.0):
    """BCE + (1 - SSIM) of binary maps (myloss.py:55-70)."""
    prob = torch.sigmoid(logits)
    t = target01.to(prob.dtype)
    return _bce_with_logits(logits, t) + (
        1.0 - ssim_same(prob, t, data_range=data_range))


def bce_dice_loss(logits, target01):
    """BCE + binary dice (myloss.py's BCE_DICE)."""
    prob = torch.sigmoid(logits)
    t = target01.to(prob.dtype)
    return _bce_with_logits(logits, t) + dice_binary(prob, t)


def ce_dice_iou_loss(logits, labels):
    """CE + dice + IoU on the class-1 probability (myloss.py's
    CE_DICE_IOU)."""
    prob_fg = torch.softmax(logits, dim=1)[:, 1]
    t = labels > 0
    return (softmax_cross_entropy(logits, labels) + dice_binary(prob_fg, t)
            + _binary_iou(prob_fg, t))


def bce_ssim_iou_bd_loss(logits, target01, bd_pred, bd_target,
                         data_range: float = 1.0):
    """BCE + SSIM + IoU plus the MSE of a predicted boundary map against
    ``rbd / 255`` (myloss.py:73-90)."""
    bd = torch.mean((bd_pred - bd_target.float() / 255.0) ** 2)
    return bce_ssim_iou_loss(logits, target01, data_range) + bd


def hausdorff_er_loss(logits, labels, alpha: float = 2.0, erosions: int = 3):
    """Erosion-based Hausdorff loss (hausdorff.py:107-173): the squared
    error map, eroded ``erosions`` times by a 3x3 mean filter, each level's
    mean scaled by ``k^alpha``."""
    probs = torch.softmax(logits, dim=1)[:, 1]
    err = (probs - (labels > 0).to(probs.dtype)) ** 2
    kernel = torch.full((1, 1, 3, 3), 1.0 / 9.0, dtype=probs.dtype,
                        device=probs.device)
    loss = 0.0
    cur = err[:, None]
    for k in range(erosions):
        loss = loss + torch.mean(cur) * ((k + 1) ** alpha)
        cur = F.relu(F.conv2d(cur, kernel, padding=1) * 2.0 - 1.0) * cur
    return loss
